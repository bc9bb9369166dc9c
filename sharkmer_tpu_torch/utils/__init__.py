from .levenshtein import bounded_levenshtein  # noqa: F401
