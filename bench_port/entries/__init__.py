"""Entries: the system under test for a traffic mix, one module each,
found by the mix's ``entry`` name."""
