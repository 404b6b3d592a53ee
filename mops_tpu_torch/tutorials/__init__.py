"""The reference tutorials on the port (streamline, pathline, remapping,
regrid), run as ``python -m mops_tpu_torch.tutorials.<name>``; each runs on
the card unless given ``--device cpu``."""
