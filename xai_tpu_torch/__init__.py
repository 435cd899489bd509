"""xai_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``xai_tpu``.

Module names mirror ``xai_tpu`` so each piece has an obvious counterpart:

- ``models``   — the ResNet, ViT and CLIP families as ``nn.Module``s with
  taps and probes (NCHW inside)
- ``convert``  — the weight carry from ``xai_tpu``'s saved ``.npz`` params
- ``methods``  — every CNN attribution of the registry: the gradient
  path (grad, input×grad, IG, LIG, IDG, IDGI, SmoothGrad), LIME, guided
  backprop and Grad-CAM, the ablation family, RISE, AGI, Guided IG, XRAI;
  the ViT and CLIP explainers; and their batched forms
- ``metrics``  — the 10-score perturbation battery (ranked-reveal curves)
- ``ops``      — preprocessing, the blur substrate, quickshift
  superpixels, resizes, curve statistics
- ``native``   — XRAI's Felzenszwalb segmenter (C++, g++ at first use)
- ``kernels``  — hand-written CUDA kernels for ``sm_90a`` (built at first
  use with ``nvcc``) and their plain PyTorch versions
- ``data``     — ImageNet-val stream, class maps, the CLIP tokenizer with
  its own copies of the BPE vocabulary and the class names
- ``runners``  — CLI drivers with the reference's flags

Public functions keep ``xai_tpu``'s layouts (images ``[H, W, C]``, saliency
``[H, W]``); the models run NCHW.  Entry points run on CUDA unless the
caller passes ``device="cpu"``; a kernel wrapper given a CPU tensor runs its
plain PyTorch version, and given a CUDA tensor launches its kernel or raises.

Nothing here imports ``jax`` or ``xai_tpu``.
"""

__version__ = "0.1.0"
