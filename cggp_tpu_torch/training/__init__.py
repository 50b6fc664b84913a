"""Serving loops (``predict_in_batches``)."""
