"""`python -m dllama_tpu_torch` — the `dllama` binary equivalent on PyTorch."""

from dllama_tpu_torch.cli.main import main

raise SystemExit(main())
