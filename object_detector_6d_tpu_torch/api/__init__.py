"""api subpackage."""
