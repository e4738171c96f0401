from .transformer import ARConfig, generate_tokens, init_params  # noqa: F401
