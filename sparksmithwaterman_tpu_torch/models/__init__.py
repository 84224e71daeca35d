"""Backends and the directory pipeline of the port."""
