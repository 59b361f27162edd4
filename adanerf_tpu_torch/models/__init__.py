"""The oracle (BaseNet) and shading (NeRF) MLPs as nn.Modules."""
