"""Host media boundary: video decode on the host."""
