"""``python -m repro_torch.fl.obs summarize <run-dir>``; see summarize.py."""
import sys

from repro_torch.fl.obs.summarize import main

if __name__ == "__main__":
    sys.exit(main())
