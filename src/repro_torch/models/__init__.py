"""Model code: shared layers and the dense transformer train path."""
