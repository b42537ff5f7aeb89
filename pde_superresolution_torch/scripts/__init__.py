"""Command-line entry points of the port (``python -m
pde_superresolution_torch.scripts.<name>``)."""
