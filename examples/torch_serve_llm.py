"""Serve a (reduced) language-model architecture on the PyTorch port with
batched prefill + decode: the KV cache, slots and greedy decode of
``repro_torch.launch.serve``, for any LM ``--arch`` in the registry. The
counterpart of ``examples/serve_llm.py``.

Run:  PYTHONPATH=src python examples/torch_serve_llm.py --arch gemma2-9b
      (on CUDA; add ``--device cpu`` to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402

if __name__ == "__main__":
    serve_main(["--smoke"] + sys.argv[1:])
