"""One file per model family: the port's config and the drawn weights."""
