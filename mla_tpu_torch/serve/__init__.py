"""Streaming inference: the single-stream tagger and the batched server."""
