"""Model code of the PyTorch port: layers, attention, the transformer
assembly and the weight converter from the reference pytree."""
