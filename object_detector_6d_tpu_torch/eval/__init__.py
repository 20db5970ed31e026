"""eval subpackage."""
