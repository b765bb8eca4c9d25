"""The frozen plain NumPy reference that decides ``correct``."""
