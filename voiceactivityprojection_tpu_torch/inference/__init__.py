"""Inference entry points of the port: offline extraction from audio files."""
