"""ppf subpackage."""
