"""Token data: synthetic and memmap sources, the batch loader."""
