"""Scoring (and, in a later slice, training) of the port."""
