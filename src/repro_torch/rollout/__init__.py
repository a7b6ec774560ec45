"""Paged continuous-batching serving engine."""
