"""Single-device Q-GaLore training of the port."""
