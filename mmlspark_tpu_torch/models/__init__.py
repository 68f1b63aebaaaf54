"""Models of the port: bundles, architectures, the zoo and TorchModel."""
