"""`python -m sodt_tpu_torch.train`: the training CLI (`train/cli.py`)."""

from .cli import main

if __name__ == "__main__":
    main()
