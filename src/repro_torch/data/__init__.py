"""The deterministic synthetic data stream training reads
(``pipeline``)."""
