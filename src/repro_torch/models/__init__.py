"""Architecture substrate: dense GQA transformer layers."""
