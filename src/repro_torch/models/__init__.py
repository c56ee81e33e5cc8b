"""Decoder LM (dense family) over the port's layers."""
