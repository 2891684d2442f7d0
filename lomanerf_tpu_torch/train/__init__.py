"""Drivers: params fixtures and the orbit renderer."""
