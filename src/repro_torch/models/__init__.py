"""Dense LLaMA decoder of the port."""
