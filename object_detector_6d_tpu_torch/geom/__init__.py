"""geom subpackage."""
