"""Host media boundary: video decode and encode, the real-time stream, and
image-tree readers, on the host."""
