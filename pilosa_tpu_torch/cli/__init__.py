"""CLI of the port (the reference's cmd/ tree; `server` for one node)."""

from pilosa_tpu_torch.cli.main import main  # noqa: F401
