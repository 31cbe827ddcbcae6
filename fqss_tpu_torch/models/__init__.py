"""Models, the model factory and the bridge from JAX variables."""
