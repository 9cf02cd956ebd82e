"""Station kinds of the capture generator, one file a kind
(``capture.py``'s notes)."""
