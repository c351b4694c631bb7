"""Entry points of the port's language-model path (serving)."""
