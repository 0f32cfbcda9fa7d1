"""Training losses of the reference: adversarial, parsing CE, VGG19."""
