"""Plain references, in plain PyTorch: they import nothing of the port and
nothing of JAX, and take nothing the port has made."""
