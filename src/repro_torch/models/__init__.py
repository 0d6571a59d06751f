"""Paper-plane FL models (CNN-1/2, ResNet-10/18) and the bridge autoencoder."""
