"""Whole-scene evaluation: the vote protocol and its driver."""
