"""Detector plug-ins of the camera cells, one module a detector, found by
the name in a configuration's ``detector`` key (``run.detector``)."""
