"""The training path of the port: optimizer, gradient compression, train step."""
