from .numwords import num_to_words  # noqa: F401
from .retokenize import encode, remove_punctuation, split_tokens_on_spaces  # noqa: F401
