"""Token sampling: the host-side sampler chain."""
