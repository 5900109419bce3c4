from .datagen import generate_binomial, generate_redundant, generate_single_symbol

__all__ = ["generate_redundant", "generate_binomial", "generate_single_symbol"]
