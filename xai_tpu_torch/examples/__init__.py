"""Walkthroughs of the library API, the counterparts of xai_tpu's
``examples/cnn_example.py``, ``vit_example.py`` and ``clip_example.py``
(the reference's CNN, ViT and CLIP notebooks as scripts).  Each runs as
``python -m xai_tpu_torch.examples.<name>``; its ``run`` does the work on a
bundle and an input, and ``main`` parses the flags and calls it."""
