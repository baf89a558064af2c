"""Test support: deterministic fault injection (``testing.chaos``)."""
