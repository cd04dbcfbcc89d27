"""Plain PyTorch references of the benchmark's checks; they import nothing of the port."""
