"""File formats the port reads and writes in its own code."""


class ImageError(ValueError):
    """An image file the port's readers do not take: the base of
    ``png.PngError`` and ``jpeg.JpegError`` (``io/image.py`` dispatches
    between them)."""
