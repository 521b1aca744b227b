"""The plain references the benchmark holds the port to.  They import torch
and numpy only: nothing of JAX, of the JAX package or of the port."""
