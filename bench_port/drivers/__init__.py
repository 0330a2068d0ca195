"""One driver per kind of traffic (``"kind"`` in a traffic file)."""
