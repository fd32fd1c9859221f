"""Video utilities (``crop-background``)."""
