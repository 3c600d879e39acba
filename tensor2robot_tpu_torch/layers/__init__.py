"""Network layers: the SNAIL blocks, the vision tower with its spatial
softmax head."""
