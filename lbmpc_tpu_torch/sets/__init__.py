"""Polytopic set toolchain (numpy/scipy, host side)."""
