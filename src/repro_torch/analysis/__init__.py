"""Analysis tools of the port: analytic FLOPs and bytes per step, the
H100 roofline, and the Markdown report."""
