"""The FDGAN generator and its DenseNet-121 and decoder blocks."""
