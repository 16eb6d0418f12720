"""Render-path helpers shared by the kernels' host side."""
