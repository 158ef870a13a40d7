"""One generator module per traffic kind (``kind`` in a traffic file): each
defines ``run(cell) -> dict``."""
