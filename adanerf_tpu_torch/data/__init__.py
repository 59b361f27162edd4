"""Data layer of the port: PNG decoding, the view-cell dataset, pixel
sampling and batch prefetching (numpy on the host)."""
