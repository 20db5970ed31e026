"""quant subpackage."""
