"""The paper's pipelines (kNN, K-Means, GNB, GMM, RF) and the estimator
API.
Submodules are imported where used: ``core.knn`` and friends import the
kernel dispatch, which must not run at package import."""
