"""Video training, on the port.

Run as ``python -m endodav_tpu_torch.cli.train_end_to_end_video --data_path
<tree> --log_dir <dir> [flags]``, the first command of
``scripts/train_video.sh``: seeds Python's and numpy's generators with 314
(`endodav_tpu/cli/train_end_to_end_video.py`), then `Trainer(opts).train()`
writes ``<log_dir>/<model_type>/models/{opt.json, results.txt,
weights_<epoch>, weights_last}``.  Every ``--model_type`` trains (endodav,
endodac with ``--encoder`` vits or vitb, afsfm), in ``--compute_dtype``
float32 or bfloat16; ``scripts/train_video_dac1.sh``'s command runs as it
stands.
"""

from __future__ import annotations

import random

import numpy as np

from endodav_tpu_torch.options import EndoDAVOptions
from endodav_tpu_torch.train.trainer import Trainer


def main(args=None):
    opts = EndoDAVOptions().parse(args)
    random.seed(314)
    np.random.seed(314)
    trainer = Trainer(opts)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
