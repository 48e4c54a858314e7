"""The plain NeRF that decides ``correct``: float32 PyTorch, TF32 off,
nothing of the program and nothing of JAX."""
