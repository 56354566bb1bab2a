"""Bit-exact functional model of the crossbar datapath (dense PyTorch)."""
