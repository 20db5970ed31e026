"""match subpackage."""
