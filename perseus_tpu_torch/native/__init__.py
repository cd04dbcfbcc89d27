"""Native (C++) host components. See io.py for the batch image decoder."""
