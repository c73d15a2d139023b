"""The paper's own experiment (Sec. VI): the 784-20-10 MLP federation."""
