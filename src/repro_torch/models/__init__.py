"""Model zoo of the port: the paper's GCN (SAGE and GAT wait for a later
slice) and the LM stack's dense GQA models (``models.lm``)."""
