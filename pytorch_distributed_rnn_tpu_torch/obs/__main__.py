import sys

from pytorch_distributed_rnn_tpu_torch.obs.cli import main

if __name__ == "__main__":
    sys.exit(main())
