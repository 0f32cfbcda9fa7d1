"""Training losses of the port: adversarial, parsing CE, VGG19 perceptual."""
