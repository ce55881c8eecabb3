"""The plain float32 references, one file per model family; they import
neither the port nor the JAX package."""
