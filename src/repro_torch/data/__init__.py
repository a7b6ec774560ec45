"""Tokenizer constants (a copy of ``repro.data.tokenizer``)."""
