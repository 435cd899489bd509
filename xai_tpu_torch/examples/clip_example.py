"""CLIP walkthrough: Grad-ECLIP, MaskCLIP, self-attention and GAME
heatmaps of an image for a caption.

The counterpart of xai_tpu's ``examples/clip_example.py``.  Run:

    python -m xai_tpu_torch.examples.clip_example [--image f.jpg]
        [--params p.npz] [--bpe bpe_simple_vocab_16e6.txt.gz
        --caption "a photo of a cat"] [--device cuda]

Without ``--bpe`` the caption is the first row of the bundle's class
table, and GAME's tokens are ``[[49406, 320, 49407, 0]]``, as xai_tpu's
walkthrough has them.
"""
from __future__ import annotations

import torch

from ..data.tokenizer import SimpleTokenizer
from ..methods import clip_explain as CE
from .common import bundle_and_input, parser

# xai_tpu's walkthrough's stand-in tokens: start, "a", end, padding
STAND_IN_TOKENS = [[49406, 320, 49407, 0]]


def caption(bundle, bpe: str = "", text: str = ""):
    """(normalized embedding ``[1, E]``, ids ``[1, L]``) of the caption:
    ``text`` tokenized with the vocabulary at ``bpe``, or without one the
    class table's first row and the stand-in tokens."""
    if not bpe:
        return (bundle.extras["text_embeddings"][:1],
                torch.tensor(STAND_IN_TOKENS, device=bundle.device))
    tokens = torch.as_tensor(SimpleTokenizer(bpe).tokenize([text]),
                             dtype=torch.int64, device=bundle.device)
    with torch.no_grad():
        txt = bundle.module.encode_text(tokens).float()
    return txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True), tokens


def run(bundle, x, txt, tokens) -> dict:
    """The four ``[P, P]`` patch maps of the normalized ``[H, W, 3]``
    input ``x`` for the caption (``txt`` ``[1, E]``, ``tokens`` ``[1,
    L]``): ``{name: map}``."""
    xb = x[None]
    maps = {
        "grad_eclip": lambda: CE.grad_eclip(bundle, xb, txt),
        "maskclip": lambda: CE.mask_clip(bundle, xb, txt),
        "selfattn": lambda: CE.self_attn(bundle, xb),
        "game": lambda: CE.game(bundle, xb, tokens),
    }
    out = {}
    for name, fn in maps.items():
        out[name] = fn()[0].float().detach().cpu().numpy()
        print(f"{name:10s} [P,P]={out[name].shape} "
              f"sum={out[name].sum():.5f}")
    return out


def main(argv=None) -> dict:
    p = parser("Grad-ECLIP, MaskCLIP, self-attention and GAME of CLIP "
               "ViT-B/16")
    p.add_argument("--bpe", default="",
                   help="a BPE vocabulary (bpe_simple_vocab_16e6.txt.gz)")
    p.add_argument("--caption", default="a photo of a dog")
    args = p.parse_args(argv)
    bundle, _, x = bundle_and_input(args, "CLIP16")
    return run(bundle, x, *caption(bundle, args.bpe, args.caption))


if __name__ == "__main__":
    main()
