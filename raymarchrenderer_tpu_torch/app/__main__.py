import sys

from raymarchrenderer_tpu_torch.app.cli import main

if __name__ == "__main__":
    sys.exit(main())
