"""Photonic accelerator evaluation substrate (paper Sec. V).

Transaction-level simulation of OXBNN vs ROBIN vs LIGHTBULB on the four
evaluated BNNs; device parameters from Tables I and III.
"""
