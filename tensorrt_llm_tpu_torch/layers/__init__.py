"""Model building blocks of the port (nn.Modules)."""
