"""End-to-end examples of the port, importable so that a checkout can
drive them (``examples.train_gpt2.main``)."""
