"""Data layer of the port: PNG decoding and encoding, camera paths, the
view-cell dataset, pixel sampling and batch prefetching (numpy on the
host)."""
