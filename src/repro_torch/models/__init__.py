"""The dense causal LM of the serving slice (attention + MLP blocks)."""
