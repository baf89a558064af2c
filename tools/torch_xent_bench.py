"""Check and time the port's fused cross-entropy kernels (K5 statistics, K6
backward dh and dw/db) alone, at the training paths' bf16 vocab heads, on
one card: chip_smoke.py's K5/K6 case (``chip_smoke.xent_cases``) without
the rest of that script, as a quick loop for cross-entropy kernel work.

    python3 tools/torch_xent_bench.py [--shapes gpt,bert,bert_large]
                                      [--dtypes bf16,f32] [--tree DIR]

Shapes (rows x vocab x hidden): ``gpt`` [8176, 32000, 768] (GPTConfig
.small() at 16 x 512, the tied embedding), ``bert`` [4864, 30522, 768]
(BertConfig.base(), 64 x 76 masked positions, f32 bias) and
``bert_large`` [4864, 30522, 1024] (BertConfig.large()); each in the
storage types ``--dtypes`` names (bf16, the training paths' type, by
default; f32 takes K5's and K6's f32 routes, as the program path does).
``--tree DIR`` runs the kernels of another checkout of the repo (say a
parent commit unpacked with ``git archive`` into a gitignored directory),
so that two versions are timed in one call on one card: run parent,
change, change, parent. For each shape and type it prints one JSON line: per kernel its error readings (each output and the
entries no label reaches, on their own scales), device time, plain and
library times and bound, as chip_smoke.py's kernel phase gives them; a
check that fails raises with every reading. Then the card's name and
power limit. Needs a CUDA device.
"""

import argparse
import importlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = {"gpt": (8176, 32000, 768), "bert": (4864, 30522, 768),
          "bert_large": (4864, 30522, 1024)}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="gpt,bert,bert_large")
    ap.add_argument("--dtypes", default="bf16")
    ap.add_argument("--tree", default=ROOT)
    a = ap.parse_args()
    # the K5/K6 case and the kernels of the tree's root
    sys.path.insert(0, os.path.abspath(a.tree))
    chip_smoke = importlib.import_module("chip_smoke")
    if not torch.cuda.is_available():
        print("torch_xent_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(7)
    smi = chip_smoke.nvidia_smi()
    for name in a.shapes.split(","):
        for dtype in a.dtypes.split(","):
            cases = chip_smoke.xent_cases(torch.device("cuda"), gen,
                                          *SHAPES[name], DTYPES[dtype],
                                          timed=True)
            print(json.dumps(dict(name=name, tree=a.tree, card=smi,
                                  **cases)), flush=True)
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
