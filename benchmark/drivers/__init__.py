"""One driver per kind of traffic mix (``kind`` in the mix's file)."""
