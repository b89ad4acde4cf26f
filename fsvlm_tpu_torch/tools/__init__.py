"""Command-line tools of the port (counterparts of the repository's
``tools/``), run as ``python -m fsvlm_tpu_torch.tools.<name>``: ``predict``,
``import_torch_prompts`` and ``interpret_prompt``."""
