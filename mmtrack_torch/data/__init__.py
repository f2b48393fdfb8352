"""Training data of the port: synthetic sequences, the dataset protocol,
causal frame-pair sampling, the numpy/cv2 ViPT processing and the batch
loader. numpy and cv2 only; nothing here imports the JAX package."""
