"""Model assembly of the port: encoder, transformer stacks, VAP model, weights."""
