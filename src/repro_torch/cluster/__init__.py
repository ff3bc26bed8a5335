"""Wire accounting (the cluster runtime itself waits for a later slice)."""
