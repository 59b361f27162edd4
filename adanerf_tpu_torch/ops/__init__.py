"""Pure tensor math: ray generation, depth warps, encodings, normalizations,
ray marching helpers and z-samplers."""
