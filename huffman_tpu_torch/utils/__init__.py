from .datagen import generate_redundant

__all__ = ["generate_redundant"]
