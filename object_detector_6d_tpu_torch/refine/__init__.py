"""refine subpackage."""
