from .gpt import GPTConfig, GPTForCausalLM, PRESETS  # noqa: F401
