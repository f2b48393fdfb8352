"""Tracker runtimes of the port."""
