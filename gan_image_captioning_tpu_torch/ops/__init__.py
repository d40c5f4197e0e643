"""Weight-init sweep."""
