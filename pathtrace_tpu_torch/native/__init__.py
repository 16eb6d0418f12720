"""The native host runtime: the C++ scene parser, OBJ loader and image
writers (``lib.py``)."""
