"""PyTorch and CUDA port of the GAN image-captioning framework.

A second package beside ``gan_image_captioning_tpu`` (the JAX reference,
which stays as it is).  Module paths and function names mirror the JAX
package so each counterpart is easy to find; inside, the code is PyTorch:
``nn.Module``s or plain functions on tensors, an explicit ``device`` and an
explicit ``torch.Generator`` wherever randomness is drawn.  Every Pallas
kernel on a ported path becomes a hand-written Hopper kernel under
``kernels/csrc`` with a plain PyTorch version beside it.

Entry points: ``serve.py`` (caption serving), ``main.py`` (training),
``evaluate.py`` (NLL_gen, BLEU-4 and the caption-quality metrics) and
``caption.py`` (captions of a split: greedy, beam or sampled); what is
ported and what waits is in ``ROADMAP.md``.

The port imports ``torch`` and never ``jax`` or the JAX package.  Entry
points run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
