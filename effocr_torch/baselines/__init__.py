"""Baselines the JAX package compares EffOCR against: the seq2seq
(TrOCR-style) line recognizer (seq2seq.py, data.py)."""
