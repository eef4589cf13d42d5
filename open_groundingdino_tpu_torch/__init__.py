"""open_groundingdino_tpu_torch — the PyTorch/CUDA port of open_groundingdino_tpu.

A second package beside the JAX one, held against it module by module on the
same weights and inputs.  The serving path runs today:

    from open_groundingdino_tpu_torch.inference import load_model, predict
    im = load_model(cfg_path, ckpt_pth, vocab_txt)          # device="cuda"
    boxes, scores, phrases = predict(im, pil_image, "cat . dog .")

Plain tensor code is PyTorch; the two kernels of this path are written by
hand in CUDA C++ for Hopper (csrc/): multi-scale deformable attention
(ops/msda.py) and the bidirectional image<->text fusion attention
(ops/fusion.py).  Each wrapper launches its kernel for CUDA tensors and takes
its plain PyTorch version for CPU tensors, which is how the tests run.

The package imports neither JAX nor the JAX package: it keeps its own copies
of the pure-Python pieces it needs (config loader, tokenizer, transforms).
"""

__version__ = "0.1.0"
