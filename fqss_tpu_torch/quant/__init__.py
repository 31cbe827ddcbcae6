"""Quantization core: the QuantSpec plan, fake-quant grids and quantizer modules."""
